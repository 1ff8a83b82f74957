"""pw.io.sqlite — SQLite input connector (reference:
python/pathway/io/sqlite + native SqliteReader, data_storage.rs:1407 —
snapshot + change polling keyed on rowid/data_version)."""

from __future__ import annotations

import sqlite3
import time

from pathway_tpu_torch.internals.api import ref_scalar
from pathway_tpu_torch.internals.schema import Schema
from pathway_tpu_torch.io.python import ConnectorSubject, read as python_read


class _SqliteSubject(ConnectorSubject):
    def __init__(self, path, table_name, schema, mode, refresh_interval):
        super().__init__()
        self.path = path
        self.table_name = table_name
        self.schema = schema
        self.mode = mode
        self.refresh_interval = refresh_interval
        self._stop = False
        self._live: dict = {}  # key -> row values

    def _scan(self):
        cols = self.schema.column_names()
        pkeys = self.schema.primary_key_columns()
        con = sqlite3.connect(self.path)
        try:
            cur = con.execute(
                f"SELECT {', '.join(cols)} FROM {self.table_name}"
            )
            current = {}
            for rec in cur.fetchall():
                values = dict(zip(cols, rec))
                if pkeys:
                    key = ref_scalar(*(values[c] for c in pkeys))
                else:
                    key = ref_scalar("sqlite", *rec)
                current[key] = values
        finally:
            con.close()
        # diff against previous snapshot: upserts + deletions
        for key, values in current.items():
            prev = self._live.get(key)
            if prev != values:
                if prev is not None:
                    self._remove(key, prev)
                self._upsert(key, values)
        for key in list(self._live):
            if key not in current:
                self._remove(key, self._live[key])
        self._live = current
        self.commit()

    def run(self):
        self._scan()
        if self.mode == "static":
            return
        while not self._stop:
            time.sleep(self.refresh_interval)
            self._scan()

    def on_stop(self):
        self._stop = True

    def snapshot_state(self):
        return {"live": dict(self._live)}

    def seek(self, state):
        self._live = dict(state.get("live", {}))


def read(
    path: str,
    table_name: str,
    schema: type[Schema],
    *,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    refresh_interval: float = 1.0,
    name: str | None = None,
    **kwargs,
):
    subject = _SqliteSubject(path, table_name, schema, mode, refresh_interval)
    return python_read(
        subject,
        schema=schema,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name or f"sqlite:{path}:{table_name}",
    )
