"""pw.io.fs — filesystem connector (reference: python/pathway/io/fs +
src/connectors/scanner/filesystem.rs:139 — glob polling with metadata and
deletion detection).

Static mode materialises matching files once; streaming mode polls the glob
for new/modified files on a connector thread.
"""

from __future__ import annotations

import csv as _csv
import glob as _glob
import json as _json
import os
import time
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import Json, ref_scalar
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import Schema, schema_from_types
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import Universe
from pathway_tpu_torch.io.python import ConnectorSubject, read as python_read


def _iter_paths(path: str) -> list[str]:
    if os.path.isdir(path):
        out = []
        for root, _, files in os.walk(path):
            for f in sorted(files):
                out.append(os.path.join(root, f))
        return sorted(out)
    return sorted(_glob.glob(path))


def _parse_file(path: str, fmt: str, value_columns, schema_cols, with_metadata):
    rows: list[dict] = []
    if fmt in ("csv", "dsv"):
        with open(path, newline="") as f:
            for rec in _csv.DictReader(f):
                rows.append({k: _coerce(v) for k, v in rec.items()})
    elif fmt in ("json", "jsonlines"):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(_json.loads(line))
    elif fmt == "plaintext":
        with open(path) as f:
            for line in f:
                rows.append({"data": line.rstrip("\n")})
    elif fmt == "plaintext_by_file":
        with open(path) as f:
            rows.append({"data": f.read()})
    elif fmt == "binary":
        with open(path, "rb") as f:
            rows.append({"data": f.read()})
    else:
        raise ValueError(f"unknown format {fmt!r}")
    if with_metadata:
        st = os.stat(path)
        meta = {
            "path": os.path.abspath(path),
            "size": st.st_size,
            "modified_at": int(st.st_mtime),
            "seen_at": int(time.time()),
        }
        for r in rows:
            r["_metadata"] = Json(meta)
    return rows


def _coerce(v: str):
    if v is None:
        return None
    try:
        return int(v)
    except (ValueError, TypeError):
        pass
    try:
        return float(v)
    except (ValueError, TypeError):
        pass
    if v == "True":
        return True
    if v == "False":
        return False
    return v


class _FsSubject(ConnectorSubject):
    # multi-process runs: every rank scans, each owns the paths that hash
    # to it (reference: per-worker partitioned reads, data_storage.rs:692)
    _distributed_partitioned = True

    def __init__(self, path, fmt, schema, with_metadata, mode, refresh_interval=0.2):
        super().__init__()
        self.path = path
        self.fmt = fmt
        self.schema = schema
        self.with_metadata = with_metadata
        self.mode = mode
        self.refresh_interval = refresh_interval
        self._seen: dict[str, float] = {}
        self._emitted: dict[str, list] = {}
        self._stop = False

    def _owns(self, path: str) -> bool:
        """THE ownership predicate: does this rank scan ``path`` under
        the current world? Shards by the path RELATIVE to the source
        root (absolute paths differ across ranks with different
        mounts/cwds, which would let two ranks own the same file — or
        none own it). Shared by the live scan (``_owned_paths``) and
        the rescale re-shard of committed scan state
        (``reshard_scan_state``), so the two can never drift."""
        from pathway_tpu_torch.internals.config import get_pathway_config
        from pathway_tpu_torch.parallel.procgroup import stable_shard

        c = get_pathway_config()
        if c.processes <= 1:
            return True
        root = self.path if os.path.isdir(self.path) else (
            os.path.dirname(self.path) or "."
        )
        rel = os.path.relpath(path, root)
        return stable_shard(rel, c.processes) == c.process_id

    def _owned_paths(self):
        for p in _iter_paths(self.path):
            if self._owns(p):
                yield p

    def _scan_once(self):
        # modified-file diffing + deletion detection (reference:
        # src/connectors/scanner/filesystem.rs object cache)
        current = set()
        for p in self._owned_paths():
            try:
                mtime = os.path.getmtime(p)
            except OSError:
                continue
            current.add(p)
            if self._seen.get(p) == mtime:
                continue
            for old_key, old_row in self._emitted.pop(p, []):
                self._remove(old_key, old_row)
            rows = _parse_file(
                p, self.fmt, None, self.schema.column_names(), self.with_metadata
            )
            # stable per-(path, line) keys so deleting a file retracts ITS
            # rows even when identical content exists in other files
            keyed = [
                (ref_scalar("fs", os.path.abspath(p), i), row)
                for i, row in enumerate(rows)
            ]
            for key, row in keyed:
                self._upsert(key, row)
            # scan state recorded only AFTER the rows are emitted, so a
            # flush snapshot can never claim a file whose rows it lacks
            self._emitted[p] = keyed
            self._seen[p] = mtime
        for p in list(self._emitted):
            if p not in current:
                for old_key, old_row in self._emitted.pop(p, []):
                    self._remove(old_key, old_row)
                self._seen.pop(p, None)
        self.commit()

    def run(self):
        self._scan_once()
        if self.mode == "static":
            return
        while not self._stop:
            time.sleep(self.refresh_interval)
            self._scan_once()

    def on_stop(self):
        self._stop = True

    # -- persistence hooks (reference: Reader::seek, data_storage.rs:394;
    # scanner object cache, scanner/filesystem.rs) -------------------------
    def snapshot_state(self):
        return {"seen": dict(self._seen), "emitted": dict(self._emitted)}

    def seek(self, state) -> None:
        self._seen = dict(state.get("seen", {}))
        self._emitted = dict(state.get("emitted", {}))

    def reshard_scan_state(self, states: list) -> dict:
        """Elastic-mesh rescale (persistence/reshard.py): merge every
        old rank's scan state and keep the paths THIS rank owns under
        the new world — the SAME ``_owns`` predicate the live scan
        shards with, so a re-sharded restore never re-reads a committed
        file and never retracts another rank's rows as 'deleted'. Runs
        even for a single old state (a 1→N grow must still re-filter
        the full old coverage per new rank)."""
        seen: dict = {}
        emitted: dict = {}
        for st in states:
            for p, mtime in st.get("seen", {}).items():
                if self._owns(p) and p not in seen:
                    seen[p] = mtime
            for p, keyed in st.get("emitted", {}).items():
                if self._owns(p) and p not in emitted:
                    emitted[p] = keyed
        return {"seen": seen, "emitted": emitted}


def _infer_schema(path: str, fmt: str, with_metadata: bool) -> type[Schema]:
    if fmt in ("plaintext", "plaintext_by_file"):
        cols: dict[str, Any] = {"data": dt.STR}
    elif fmt == "binary":
        cols = {"data": dt.BYTES}
    else:
        sample_rows: list[dict] = []
        for p in _iter_paths(path)[:3]:
            sample_rows.extend(
                _parse_file(p, fmt, None, [], False)[:20]
            )
        names: list[str] = []
        for r in sample_rows:
            for k in r:
                if k not in names:
                    names.append(k)
        cols = {}
        for name in names:
            vals = [r.get(name) for r in sample_rows if name in r]
            cols[name] = dt.lub(*(dt.dtype_of_value(v) for v in vals)) if vals else dt.ANY
    if with_metadata:
        cols["_metadata"] = dt.JSON
    return schema_from_types(**cols)


def read(
    path: str,
    *,
    format: str = "csv",
    schema: type[Schema] | None = None,
    mode: str = "streaming",
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    refresh_interval: float = 0.2,
    name: str | None = None,
    **kwargs,
) -> Table:
    if format == "plaintext_by_object":
        format = "plaintext_by_file"
    if schema is None:
        schema = _infer_schema(path, format, with_metadata)
    elif with_metadata and "_metadata" not in schema.column_names():
        from pathway_tpu_torch.internals.schema import ColumnDefinition, schema_builder

        cols = dict(schema.columns())
        cols["_metadata"] = ColumnDefinition(dtype=dt.JSON, name="_metadata")
        schema = schema_builder(cols)
    if mode == "static":
        # materialise immediately as a static table
        rows = []
        seq = 0
        pkeys = schema.primary_key_columns()
        cols = schema.column_names()
        defaults = schema.default_values()
        for p in _iter_paths(path):
            for row in _parse_file(p, format, None, cols, with_metadata):
                values = tuple(row.get(c, defaults.get(c)) for c in cols)
                if pkeys:
                    key = ref_scalar(*(row[c] for c in pkeys))
                else:
                    key = ref_scalar("fs", p, seq)
                seq += 1
                rows.append((key, *values))
        from pathway_tpu_torch.debug import table_from_rows

        return table_from_rows(schema, rows)
    subject = _FsSubject(path, format, schema, with_metadata, mode, refresh_interval)
    return python_read(
        subject,
        schema=schema,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name or f"fs:{path}",
    )


def write(table: Table, filename: str, *, format: str = "csv", name: str | None = None, **kwargs) -> None:
    """Write the table's change stream to ``filename`` through the
    transactional egress plane (io/txn.py): rows are STAGED
    per commit timestamp and become visible only by atomic rename — a
    crash mid-write can never leave a partial file visible. Under
    ``OPERATOR_PERSISTING`` the sink is epoch-aligned: staged output
    finalizes only when the engine's ``snapshot_commit`` marker lands,
    so the committed file is bit-identical across any rollback or
    rescale; without it, segments finalize at every commit timestamp
    (the documented at-least-once boundary)."""
    from pathway_tpu_torch.io.txn import TxnFileSink

    cols = table.column_names()
    sink = TxnFileSink(filename, format=format, cols=cols)

    def lower(ctx):
        # columnar egress: NativeBatch deliveries arrive as
        # Arrow record batches (on_batch_arrow) and serialize straight
        # off the columns; tuple deltas (retractions, object columns,
        # PATHWAY_NO_NB_CAPTURE) keep the row path — both encode to
        # bit-identical bytes
        ctx.scope.output(
            ctx.engine_table(table),
            on_batch=sink.on_batch,
            on_batch_arrow=sink.on_batch_arrow,
            arrow_cols=cols,
            on_time_end=sink.on_time_end,
            on_end=sink.on_end,
            txn_sink=sink,
        )

    G.add_operator([table], [], lower, f"fs_write_{format}", is_output=True)
