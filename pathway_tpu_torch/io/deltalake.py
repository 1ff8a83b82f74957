"""pw.io.deltalake — Delta Lake connector (reference:
python/pathway/io/deltalake over the native DeltaTableReader/Writer,
src/connectors/data_storage.rs:1902/:1611).

Redesigned transport: no delta-rs — the Delta Lake format IS an open
spec (parquet parts + a JSON transaction log under ``_delta_log/``), and
pyarrow is in the image, so this build implements the protocol directly:

* ``write`` appends one parquet part + one log version per non-empty
  commit window, with ``protocol``/``metaData`` actions minted at table
  creation (schema inferred from the table's dtypes);
* ``read`` polls ``_delta_log`` versions in order and ingests the
  ``add`` actions of each (append-only semantics, like the reference's
  reader at io/deltalake/__init__.py:38).

Storage rides a small store abstraction: local filesystem, or any
S3-compatible object store through the dependency-free SigV4 transport
(io/_s3.py) — ``s3://bucket/prefix`` lakes read and write directly on
object storage like the reference (data_storage.rs:1611,1902), with
log-commit exclusivity via conditional PUT (``If-None-Match: *``).
"""

from __future__ import annotations

import io as _io
import json as _json
import os
import time
import uuid
from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.api import ref_scalar
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.schema import Schema
from pathway_tpu_torch.io.python import ConnectorSubject, read as python_read

__all__ = ["read", "write"]

_DELTA_TYPES = {
    dt.INT: "long",
    dt.FLOAT: "double",
    dt.STR: "string",
    dt.BOOL: "boolean",
    dt.BYTES: "binary",
}


class _LocalStore:
    """Lake storage on the local filesystem."""

    def __init__(self, root: str):
        self.root = root

    def read(self, rel: str) -> bytes | None:
        try:
            with open(os.path.join(self.root, rel), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def write(self, rel: str, data: bytes) -> None:
        # write-temp + atomic rename: object-store PUTs are atomic, and
        # the transactional writer's manifests (the durable pre-commit
        # record) must never be observable half-written on local disk
        path = os.path.join(self.root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp-{uuid.uuid4().hex[:8]}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def write_exclusive(self, rel: str, data: bytes) -> None:
        """Create-if-absent (Delta log commits must be mutually
        exclusive: two writers must never both claim version N).
        os.link from a private tmp file is atomic-exclusive; filesystems
        without hard links fall back to os.replace (single-writer safe)."""
        path = os.path.join(self.root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp-{uuid.uuid4().hex}"
        with open(tmp, "wb") as f:
            f.write(data)
        try:
            os.link(tmp, path)
        except OSError as exc:
            if isinstance(exc, FileExistsError):
                raise
            os.replace(tmp, path)
            tmp = None
        finally:
            if tmp is not None:
                os.unlink(tmp)

    def list_log_versions(self) -> list[int]:
        log = os.path.join(self.root, "_delta_log")
        try:
            names = os.listdir(log)
        except FileNotFoundError:
            return []
        return sorted(
            int(f.split(".")[0])
            for f in names
            if f.endswith(".json") and f.split(".")[0].isdigit()
        )

    def list(self, prefix: str) -> list[str]:
        """Relative keys under ``prefix`` (the staging/manifest scans of
        the transactional writer). Walks only the prefix's subtree — a
        whole-lake walk would put an O(committed parts) scan on every
        snapshot cut's finalize."""
        base = os.path.join(self.root, prefix)
        if os.path.isdir(base):
            roots = [base]
        else:
            # partial-name prefix: walk the containing directory
            parent = os.path.dirname(base)
            if not os.path.isdir(parent):
                return []
            roots = [parent]
        out = []
        for root in roots:
            for dirpath, _dirs, files in os.walk(root):
                for f in files:
                    rel = os.path.relpath(
                        os.path.join(dirpath, f), self.root
                    ).replace(os.sep, "/")
                    if rel.startswith(prefix):
                        out.append(rel)
        return sorted(out)

    def delete(self, rel: str) -> None:
        try:
            os.unlink(os.path.join(self.root, rel))
        except FileNotFoundError:
            pass


class _S3Store:
    """Lake storage on an S3-compatible object store via the SigV4
    transport (reference: the delta-rs S3 log store,
    data_storage.rs:1611)."""

    def __init__(self, uri: str, settings=None, opener=None):
        from pathway_tpu_torch.io._s3 import AwsS3Settings, S3Client

        rest = uri.split("://", 1)[1]
        bucket, _, prefix = rest.partition("/")
        if settings is None:
            settings = AwsS3Settings.new_from_path(uri)
        self.client = S3Client(settings.with_bucket(bucket), opener=opener)
        self.prefix = prefix.strip("/")

    def _key(self, rel: str) -> str:
        rel = rel.replace(os.sep, "/")
        return f"{self.prefix}/{rel}" if self.prefix else rel

    def read(self, rel: str) -> bytes | None:
        import urllib.error

        try:
            return self.client.get_object(self._key(rel))
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def write(self, rel: str, data: bytes) -> None:
        self.client.put_object(self._key(rel), data)

    def write_exclusive(self, rel: str, data: bytes) -> None:
        self.client.put_object_if_absent(self._key(rel), data)

    def list_log_versions(self) -> list[int]:
        log_prefix = self._key("_delta_log/")
        out = []
        for obj in self.client.list_objects(prefix=log_prefix):
            name = obj.key.rsplit("/", 1)[-1]
            if name.endswith(".json") and name.split(".")[0].isdigit():
                out.append(int(name.split(".")[0]))
        return sorted(out)

    def list(self, prefix: str) -> list[str]:
        strip = len(self.prefix) + 1 if self.prefix else 0
        return sorted(
            obj.key[strip:]
            for obj in self.client.list_objects(prefix=self._key(prefix))
        )

    def delete(self, rel: str) -> None:
        self.client.delete_object(self._key(rel))


def _make_store(uri, s3_connection_settings=None):
    uri = str(os.fspath(uri))
    if uri.startswith(("s3://", "s3a://")):
        return _S3Store(uri, settings=s3_connection_settings)
    return _LocalStore(uri)


def _delta_type(col_dtype) -> str:
    return _DELTA_TYPES.get(col_dtype, "string")


class _DeltaSubject(ConnectorSubject):
    _deletions_enabled = False  # append-only source (reference contract)

    def __init__(self, store, columns, mode, refresh_interval=1.0):
        super().__init__()
        self.store = store
        self.columns = columns
        self.mode = mode
        self.refresh_interval = refresh_interval
        self._version = 0
        self._stop = False

    def _scan_versions(self) -> bool:
        import pyarrow.parquet as pq

        advanced = False
        while True:
            data = self.store.read(
                os.path.join("_delta_log", f"{self._version:020d}.json")
            )
            if data is None:
                return advanced
            actions = [
                _json.loads(line)
                for line in data.decode().splitlines()
                if line.strip()
            ]
            # read every referenced part BEFORE emitting any row: a part
            # not yet visible (eventually-consistent store, torn upload)
            # must not advance the version — the whole version retries on
            # the next poll; in static mode a missing part is data loss
            # and fails loudly
            parts: dict[str, bytes] = {}
            for action in actions:
                add = action.get("add")
                if add is None:
                    continue
                blob = self.store.read(add["path"])
                if blob is None:
                    if self.mode == "static":
                        raise FileNotFoundError(
                            f"delta part {add['path']!r} referenced by log "
                            f"version {self._version} is missing"
                        )
                    return advanced  # retry this version next refresh
                parts[add["path"]] = blob
            for action in actions:
                add = action.get("add")
                if add is None:
                    continue
                # use_threads=False: this runs on a connector thread, and
                # pyarrow's CPU pool first spawned from a non-main thread
                # aborts the process at exit ("terminate called without an
                # active exception", ~30% of runs on pyarrow 22); parts
                # are small, the pool buys nothing here
                table = pq.read_table(
                    _io.BytesIO(parts[add["path"]]), use_threads=False
                )
                cols = [
                    table.column(c).to_pylist()
                    if c in table.column_names
                    else [None] * table.num_rows
                    for c in self.columns
                ]
                for i in range(table.num_rows):
                    key = ref_scalar("delta", add["path"], i)
                    self._upsert(
                        key,
                        {
                            c: cols[j][i]
                            for j, c in enumerate(self.columns)
                        },
                    )
            self._version += 1
            advanced = True

    def run(self):
        self._scan_versions()
        self.commit()
        if self.mode == "static":
            return
        while not self._stop:
            time.sleep(self.refresh_interval)
            if self._scan_versions():
                self.commit()

    def on_stop(self):
        self._stop = True

    def snapshot_state(self):
        return {"version": self._version}

    def seek(self, state) -> None:
        self._version = int(state.get("version", 0))


def read(
    uri,
    schema: type[Schema],
    *,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    refresh_interval: float = 1.0,
    s3_connection_settings=None,
    name: str | None = None,
    **kwargs,
):
    """Read an append-only table from a Delta Lake — local path or
    ``s3://bucket/prefix`` (reference: io/deltalake/__init__.py:38, with
    the same AwsS3Settings-or-path-derived credentials contract :25)."""
    store = _make_store(uri, s3_connection_settings)
    subject = _DeltaSubject(
        store, schema.column_names(), mode,
        refresh_interval=refresh_interval,
    )
    return python_read(
        subject,
        schema=schema,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name or f"deltalake:{uri}",
    )


class TxnDeltaSink:
    """Transactional Delta writer (io/txn.py protocol) — and
    ROADMAP item 3's per-rank partitioned distributed output, shipped
    robustness-first: each rank writes its OWN parquet data files (no
    gather-to-rank-0 leg), and one rank appends the log version through
    the existing ``write_exclusive`` conditional-PUT path.

    Epoch-aligned two-phase commit (OPERATOR_PERSISTING runs):

    * **stage** — each rank's buffered rows flush into staged parquet
      parts under ``_pw_txn/stage/r{rank}/`` (rate-limited by
      ``min_commit_frequency`` *within* the epoch — the satellite fix:
      wall-clock autocommit no longer commits log versions the engine's
      epochs know nothing about);
    * **pre-commit** — at the snapshot cut every rank writes ONE
      durable manifest ``_pw_txn/manifest/r{rank}/{tag}.json`` naming
      its staged parts, so the set the marker commits is frozen;
    * **finalize** — after the marker lands, the log-owner rank
      (``shard_owner(0, world)``) folds ALL ranks' manifests at each
      covered tag into one log version carrying a Delta ``txn`` action
      ``{appId, version=tag}`` — the idempotence record: a re-run of
      finalize (or a recovery) skips tags the log already committed;
    * **recover** — pending manifests at-or-below the committed cut are
      (re-)committed to the log; manifests above it are discarded with
      their parts, as are orphaned staged parts of dead incarnations.
      Manifest partitions are claimed through the shared
      ``shard_owner`` mint, so after an N→M rescale the pending
      partitions of dead ranks are re-owned deterministically.

    Without OPERATOR_PERSISTING the writer behaves exactly as before
    (one part + one log version per rate-limited commit window) —
    documented at-least-once, since there is no engine cut to align
    with."""

    TXN_APP_ID = "pathway_tpu_torch-txn"

    def __init__(self, store, cols, dtypes, min_commit_frequency):
        self.store = store
        self.cols = list(cols)
        self.dtypes = list(dtypes)
        self.min_commit_frequency = min_commit_frequency
        self.name = "deltalake"
        self._buf: list[tuple] = []
        # columnar staging: Arrow record batches delivered by
        # the fused chain, kept AS BATCHES until the part flush — the
        # parquet part is written straight from the column buffers, no
        # row round-trip
        self._abuf: list[tuple] = []  # [(RecordBatch, time), ...]
        self._version: int | None = None
        self._last_commit = 0.0
        self._txn = False
        self._rank = 0
        self._world = 1
        self._epoch = 0
        self._stats = None
        self._open_parts: list[dict] = []  # staged, not yet manifested
        self._staged_tag = -1
        self._finalized_tag = -1
        self._committed_txn: set[int] | None = None
        self._log_paths: set[str] = set()
        self._scanned_upto = -1
        self._incarnation = uuid.uuid4().hex[:12]
        self._app_id = self.TXN_APP_ID

    # -- log machinery (shared by both modes) ------------------------------

    def _bootstrap_actions(self) -> list[dict]:
        fields = [
            {
                "name": c,
                "type": _delta_type(d),
                "nullable": True,
                "metadata": {},
            }
            for c, d in zip(self.cols, self.dtypes)
        ] + [
            {"name": "time", "type": "long", "nullable": False, "metadata": {}},
            {"name": "diff", "type": "long", "nullable": False, "metadata": {}},
        ]
        return [
            {"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}},
            {
                "metaData": {
                    "id": str(uuid.uuid4()),
                    "format": {"provider": "parquet", "options": {}},
                    "schemaString": _json.dumps(
                        {"type": "struct", "fields": fields}
                    ),
                    "partitionColumns": [],
                    "configuration": {},
                    "createdTime": int(time.time() * 1000),
                }
            },
        ]

    def _write_version(self, v: int, actions: list[dict]) -> None:
        # The Delta protocol requires mutually-exclusive version
        # creation: two writers must never both claim version N. The
        # store's write_exclusive raises FileExistsError if a concurrent
        # writer — a peer rank, a second pipeline or an external
        # delta-rs client — committed N first (local: atomic os.link;
        # S3: conditional PUT).
        data = "".join(_json.dumps(a) + "\n" for a in actions).encode()
        self.store.write_exclusive(
            os.path.join("_delta_log", f"{v:020d}.json"), data
        )

    def _next_version(self) -> int:
        if self._version is None:
            existing = self.store.list_log_versions()
            self._version = (max(existing) + 1) if existing else 0
            if self._version == 0:
                try:
                    self._write_version(0, self._bootstrap_actions())
                except FileExistsError:
                    pass  # a concurrent writer bootstrapped the table
                self._version = 1
        v = self._version
        self._version += 1
        return v

    def _commit(self, actions: list[dict]) -> None:
        while True:
            v = self._next_version()
            try:
                self._write_version(v, actions)
                return
            except FileExistsError:
                self._version = None  # lost the race: re-list and retry

    def _read_log_actions(self, v: int) -> list[dict]:
        data = self.store.read(
            os.path.join("_delta_log", f"{v:020d}.json")
        )
        if data is None:
            return []
        return [
            _json.loads(line)
            for line in data.decode().splitlines()
            if line.strip()
        ]

    def _scan_log(self, refresh: bool = False) -> set[int]:
        """Incremental pass over the log: the tags whose egress it
        already committed (the Delta ``txn`` action is the durable
        dedup record that makes finalize and recovery idempotent) AND
        every data path it references (committed parts live at their
        staged paths — object stores have no rename, the log reference
        IS the finalization — so the recovery orphan sweep must never
        touch them). The log is append-only, so refreshes read only
        versions newer than the last scan — a long-lived lake's
        restore does not re-fetch its whole history."""
        if self._committed_txn is None:
            self._committed_txn = set()
            self._scanned_upto = -1
        elif not refresh:
            return self._committed_txn
        for v in self.store.list_log_versions():
            if v <= self._scanned_upto:
                continue
            for action in self._read_log_actions(v):
                txn = action.get("txn")
                if txn and txn.get("appId") == self._app_id:
                    self._committed_txn.add(int(txn.get("version", -1)))
                add = action.get("add")
                if add is not None:
                    self._log_paths.add(add["path"])
            self._scanned_upto = max(self._scanned_upto, v)
        return self._committed_txn

    def _committed_txn_versions(self, refresh: bool = False) -> set[int]:
        return self._scan_log(refresh)

    # -- encoding ----------------------------------------------------------

    def _rows_to_parquet(self, rows: list[tuple]) -> bytes:
        import pyarrow as pa
        import pyarrow.parquet as pq

        arrays = {
            c: [r[j] for r in rows] for j, c in enumerate(self.cols)
        }
        arrays["time"] = [r[len(self.cols)] for r in rows]
        arrays["diff"] = [r[len(self.cols) + 1] for r in rows]
        buf = _io.BytesIO()
        pq.write_table(pa.table(arrays), buf)
        return buf.getvalue()

    def _batches_to_parquet(self, chunks: list[tuple]) -> list[bytes]:
        """Columnar part images: each buffered record batch gains its
        commit-time column and the column buffers go straight into
        parquet — zero row materialization. Batches are grouped by
        schema (an all-null column types differently across chunks)
        and each group becomes one part."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        groups: dict[str, list] = {}
        for rb, t in chunks:
            n = rb.num_rows
            arrays = [
                rb.column(rb.schema.get_field_index(c)) for c in self.cols
            ]
            arrays.append(pa.array([t] * n, pa.int64()))
            arrays.append(rb.column(rb.schema.get_field_index("diff")))
            out = pa.RecordBatch.from_arrays(
                arrays, names=self.cols + ["time", "diff"]
            )
            groups.setdefault(str(out.schema), []).append(out)
        parts = []
        for batches in groups.values():
            buf = _io.BytesIO()
            pq.write_table(pa.Table.from_batches(batches), buf)
            parts.append(buf.getvalue())
        return parts

    def _drain_payloads(self) -> list[bytes]:
        """One parquet part image per buffered representation (rows /
        per-schema arrow groups), draining both buffers."""
        out = []
        if self._buf:
            rows, self._buf = self._buf, []
            out.append(self._rows_to_parquet(rows))
        if self._abuf:
            chunks, self._abuf = self._abuf, []
            out.extend(self._batches_to_parquet(chunks))
        return out

    def _note_egress(self, seconds: float) -> None:
        from pathway_tpu_torch.io.txn import note_egress_seconds

        note_egress_seconds(self._stats, self.name, seconds)

    @staticmethod
    def _add_action(path: str, size: int) -> dict:
        return {
            "add": {
                "path": path,
                "partitionValues": {},
                "size": size,
                "modificationTime": int(time.time() * 1000),
                "dataChange": True,
            }
        }

    # -- engine callbacks --------------------------------------------------

    def on_batch(self, time_, deltas) -> None:
        t0 = time.perf_counter()
        for _k, row, d in deltas:
            self._buf.append(tuple(row) + (time_, d))
        self._note_egress(time.perf_counter() - t0)

    def on_batch_arrow(self, time_, rb) -> None:
        """Columnar delivery: buffer the record batch as-is;
        the part flush writes its column buffers directly."""
        t0 = time.perf_counter()
        if rb is not None and rb.num_rows:
            self._abuf.append((rb, time_))
        self._note_egress(time.perf_counter() - t0)

    def on_time_end(self, time_) -> None:
        if self._txn:
            self._stage_part()
        else:
            self._flush()

    def on_end(self) -> None:
        if not self._txn:
            self._flush(force=True)
        # txn mode: the runtime's final cut already pre-committed and
        # finalized the tail before on_end fires

    # -- plain (non-epoch-aligned) path ------------------------------------

    def _flush(self, force: bool = False) -> None:
        if not (self._buf or self._abuf):
            return
        if (
            not force
            and self.min_commit_frequency is not None
            and (time.monotonic() - self._last_commit) * 1000.0
            < self.min_commit_frequency
        ):
            return
        self._last_commit = time.monotonic()
        actions = []
        for data in self._drain_payloads():
            part = f"part-{uuid.uuid4().hex}.parquet"
            self.store.write(part, data)
            actions.append(self._add_action(part, len(data)))
        self._commit(actions)

    # -- the 2PC verbs -----------------------------------------------------

    def arm(
        self, *, stats=None, txn=False, rank=0, world=1, epoch=0,
        lineage=None,
    ):
        from pathway_tpu_torch.io.txn import txn_enabled

        self._stats = stats
        self._txn = txn and txn_enabled()
        self._rank = rank
        self._world = world
        self._epoch = epoch
        # the txn dedup appId is scoped to the PERSISTENCE LINEAGE
        # (a marker minted on the store's first run): snapshot tags
        # restart at 1 whenever the persistence directory is cleared,
        # and an unscoped appId would let a kept lake's OLD txn actions
        # mask the new lineage's first tags — finalize would then skip
        # the commit but still delete the manifests, silently losing
        # every row of the new run's first cuts
        if lineage:
            new_id = f"{self.TXN_APP_ID}-{lineage}"
            if new_id != self._app_id:
                self._app_id = new_id
                # any cached log scan keyed the old appId
                self._committed_txn = None
                self._scanned_upto = -1

    def _stage_dir(self, rank: int) -> str:
        return f"_pw_txn/stage/r{rank}"

    def _manifest_dir(self, rank: int) -> str:
        return f"_pw_txn/manifest/r{rank}"

    def _stage_part(self, force: bool = False) -> None:
        """Flush buffered output into staged parquet parts — invisible
        to readers (no log reference) until a finalized log version
        adds them. Row and arrow buffers stage as separate parts (one
        per representation/schema). Rate-limited within the epoch by
        min_commit_frequency; pre-commit always forces."""
        if not (self._buf or self._abuf):
            return
        if (
            not force
            and self.min_commit_frequency is not None
            and (time.monotonic() - self._last_commit) * 1000.0
            < self.min_commit_frequency
        ):
            return
        from pathway_tpu_torch.internals import faults as _faults

        _faults.fault_point("sink.stage")
        self._last_commit = time.monotonic()
        staged = 0
        for data in self._drain_payloads():
            path = (
                f"{self._stage_dir(self._rank)}/"
                f"part-{self._incarnation}-{uuid.uuid4().hex}.parquet"
            )
            self.store.write(path, data)
            self._open_parts.append({"path": path, "size": len(data)})
            staged += 1
        if staged and self._stats is not None:
            self._stats.on_sink_staged(self.name, staged)
            self._note_lag()

    def precommit(self, tag: int) -> None:
        if not self._txn:
            return
        self._stage_part(force=True)
        self._staged_tag = max(self._staged_tag, tag)
        if not self._open_parts:
            return
        manifest = {
            "tag": tag,
            "rank": self._rank,
            "parts": self._open_parts,
        }
        self.store.write(
            f"{self._manifest_dir(self._rank)}/{tag:020d}.json",
            _json.dumps(manifest).encode(),
        )
        self._open_parts = []
        self._note_lag()

    def _log_owner(self) -> bool:
        from pathway_tpu_torch.io.txn import SHARD_OWNER

        return SHARD_OWNER(0, self._world) == self._rank

    def _pending_manifests(self) -> dict[int, list[dict]]:
        """tag -> [manifest, ...] across ALL rank partitions. A
        manifest that fails to parse is a torn pre-commit leftover from
        a store without atomic writes — its cut can never have
        committed (the marker moves only after precommit completed), so
        skipping it is the discard verdict, not data loss; it must not
        turn every later recovery into a crash loop."""
        out: dict[int, list[dict]] = {}
        for key in self.store.list("_pw_txn/manifest/"):
            if ".tmp-" in key:
                continue
            raw = self.store.read(key)
            if raw is None:
                continue
            try:
                m = _json.loads(raw.decode())
                tag = int(m["tag"])
            except (ValueError, KeyError, UnicodeDecodeError):
                continue
            m["_key"] = key
            out.setdefault(tag, []).append(m)
        return out

    def _commit_tag(self, tag: int, manifests: list[dict]) -> None:
        from pathway_tpu_torch.internals import faults as _faults

        _faults.fault_point("sink.finalize")
        adds = [
            self._add_action(p["path"], p["size"])
            for m in sorted(manifests, key=lambda m: m["rank"])
            for p in m["parts"]
        ]
        self._commit(
            adds
            + [
                {
                    "txn": {
                        "appId": self._app_id,
                        "version": tag,
                        "lastUpdated": int(time.time() * 1000),
                    }
                }
            ]
        )
        self._committed_txn_versions().add(tag)
        # the just-committed parts are log-referenced data now — the
        # recovery orphan sweep must never see them as orphans
        self._log_paths.update(a["add"]["path"] for a in adds)
        if self._stats is not None:
            self._stats.on_sink_finalized(self.name, len(adds))

    def finalize(self, tag: int) -> None:
        """The marker landed at ``tag``: the log owner folds every
        covered pending manifest set into one log version per tag,
        through the shared ``sink_may_finalize`` transition."""
        if not self._txn:
            return
        self._finalized_tag = max(self._finalized_tag, tag)
        if not self._log_owner():
            self._note_lag()
            return
        from pathway_tpu_torch.io.txn import SINK_MAY_FINALIZE

        committed = self._committed_txn_versions()
        for u, manifests in sorted(self._pending_manifests().items()):
            if not SINK_MAY_FINALIZE(u, tag):
                continue
            if u not in committed:
                self._commit_tag(u, manifests)
            for m in manifests:
                self.store.delete(m["_key"])
        self._note_lag()

    def recover(self, marker_tag, world: int) -> None:
        """Restore-time scan: one shared ``sink_recover`` verdict per
        pending manifest — (re-)commit everything the cut covers,
        discard the rest with its parts. Partition claims route through
        ``shard_owner``, so a dead world's pending partitions are
        re-owned after a rescale; the log's ``txn`` actions make double
        recovery idempotent.

        Scan ORDER is load-bearing: manifests are read BEFORE the log.
        A committed part's lifecycle is manifest → log commit → manifest
        delete, so a sweeper that misses the manifest (deleted) is
        guaranteed to see the commit in its LATER log scan — reading
        the log first would open a window where a peer's concurrent
        recovery commit makes a committed part look orphaned."""
        from pathway_tpu_torch.internals import faults as _faults
        from pathway_tpu_torch.io.txn import SHARD_OWNER, SINK_RECOVER

        self._world = world
        _faults.fault_point("sink.recover")
        pending = self._pending_manifests()
        committed = self._committed_txn_versions(refresh=True)
        recovered = aborted = 0
        if marker_tag is not None and self._open_parts:
            # pre-restore staging under a committed marker: the only
            # rows staged before recovery are re-injected static rows,
            # which the restored cut already committed — keeping them
            # would re-commit them at the next cut, once per restart
            for p in self._open_parts:
                self.store.delete(p["path"])
                aborted += 1
            self._open_parts = []
        for u, manifests in sorted(pending.items()):
            verdict = SINK_RECOVER(u, marker_tag)
            if verdict == "finalize":
                # the whole tag's manifest set commits as one version:
                # the log owner claims it (every other rank leaves the
                # manifests for the owner's scan)
                if self._log_owner():
                    if u not in committed:
                        self._commit_tag(u, manifests)
                        recovered += sum(len(m["parts"]) for m in manifests)
                    for m in manifests:
                        self.store.delete(m["_key"])
                continue
            # discard: per-partition, claimed through the shard mint
            for m in manifests:
                if SHARD_OWNER(int(m["rank"]), world) != self._rank:
                    continue
                for p in m["parts"]:
                    self.store.delete(p["path"])
                    aborted += 1
                self.store.delete(m["_key"])
        # orphaned staged parts (un-manifested leftovers of dead
        # incarnations). Each rank sweeps only partitions with NO live
        # writer it could race: its OWN partition (it knows its own
        # incarnation token) and dead partitions beyond the current
        # world (claimed through the shard mint; a rank id >= world has
        # no process). Live peer partitions are left to their own
        # ranks' recoveries. Parts referenced by a pending manifest or
        # by the log are never orphans — safe under the manifest-then-
        # log scan order above.
        needed = frozenset(
            pp["path"]
            for u, ms in pending.items()
            if SINK_RECOVER(u, marker_tag) == "finalize"
            for m in ms
            for pp in m["parts"]
        )
        for key in self.store.list("_pw_txn/stage/"):
            if key in needed or key in self._log_paths:
                continue
            try:
                p = int(key.split("/r", 1)[1].split("/", 1)[0])
            except (IndexError, ValueError):
                continue
            if p == self._rank:
                if (
                    f"-{self._incarnation}-" in key
                    and marker_tag is None
                ):
                    continue  # live from-scratch staging (static rows)
            elif p < world or SHARD_OWNER(p, world) != self._rank:
                continue  # a live peer's partition, or not our claim
            self.store.delete(key)
            aborted += 1
        if self._stats is not None:
            if recovered:
                self._stats.on_sink_recovered(self.name, recovered)
            if aborted:
                self._stats.on_sink_aborted(self.name, aborted)
        if marker_tag is not None:
            self._staged_tag = max(self._staged_tag, marker_tag)
            self._finalized_tag = max(self._finalized_tag, marker_tag)
        self._note_lag()

    def abort_for_rollback(self) -> None:
        n = len(self._open_parts)
        for p in self._open_parts:
            try:
                self.store.delete(p["path"])
            except Exception:
                pass
        self._open_parts = []
        self._buf = []
        self._abuf = []
        if n and self._stats is not None:
            self._stats.on_sink_aborted(self.name, n)

    def _note_lag(self) -> None:
        if self._stats is not None and self._txn:
            self._stats.on_sink_epoch_lag(
                self.name,
                max(0, self._staged_tag - self._finalized_tag),
            )


def write(
    table,
    uri,
    *,
    min_commit_frequency: int | None = 60_000,
    s3_connection_settings=None,
    name: str | None = None,
    **kwargs,
) -> None:
    """Write the table's change stream into a Delta Lake — local path or
    ``s3://bucket/prefix`` (reference: io/deltalake/__init__.py:170 —
    output rows carry ``time`` and ``diff`` columns). Multi-rank runs
    write PARTITIONED: each rank commits its own parquet data files and
    one rank appends the log version (no gather leg). Under
    ``OPERATOR_PERSISTING`` the writer is a transactional sink: log
    commits are tied to the engine's epoch commit markers
    (``min_commit_frequency`` then rate-limits staged part writes
    *within* an epoch only), so committed lake contents are
    bit-identical across rollback and rescale (io/txn.py)."""
    store = _make_store(uri, s3_connection_settings)
    cols = table.column_names()
    schema_dtypes = table._schema_cls._dtypes()
    dtypes = [schema_dtypes.get(c) for c in cols]
    sink = TxnDeltaSink(store, cols, dtypes, min_commit_frequency)
    # per-output metrics label (two lakes in one program must not merge
    # their 2PC counters under one name)
    base = os.path.basename(str(os.fspath(uri)).rstrip("/"))
    sink.name = name or f"deltalake:{base or uri}"

    def lower(ctx):
        # per-rank partitioned egress (no gather exchange) — except in
        # the emulated-rank CI lane, where thread-ranks share one
        # process and a single writer must own the side effects
        partitioned = not getattr(
            ctx.scope.runtime, "_lane_emulated", False
        )
        ctx.scope.output(
            ctx.engine_table(table),
            on_batch=sink.on_batch,
            on_batch_arrow=sink.on_batch_arrow,
            arrow_cols=cols,
            on_time_end=sink.on_time_end,
            on_end=sink.on_end,
            txn_sink=sink,
            partitioned=partitioned,
        )

    G.add_operator([table], [], lower, "deltalake_write", is_output=True)
