"""Transactional egress — epoch-aligned two-phase-commit sinks.

The mesh is exactly-once *inside* the engine across rollback and even
across world changes, but a plain file/object-store sink re-observes the
uncommitted suffix a rollback re-emits — so every such output was
silently at-least-once under exactly the failures the rest of the stack
survives. This module closes the hole with a two-phase-commit protocol
aligned to the engine's snapshot cuts:

* **stage** — during a wave, each rank writes output into rank-scoped
  staged segment files keyed by ``(rank, epoch, commit-timestamp)``;
  nothing staged is externally visible;
* **pre-commit** — at the snapshot cut the staged set is atomically
  tagged with the cut's tag (one directory rename), so the set the
  marker will commit is frozen *before* the marker moves;
* **finalize** — only once the ``snapshot_commit`` marker has durably
  landed at-or-past the tag do staged units become visible (atomic
  renames into the finalized segment store + a write-temp/fsync/rename
  republish of the visible file — a crash mid-write can never leave a
  partial file visible);
* **recover** — on restore, recovery scans pending staged units and
  takes one verdict per unit through the shared
  :func:`~pathway_tpu_torch.parallel.protocol.sink_recover` transition:
  finalize everything at-or-below the committed cut, discard the rest.
  Staged units are ``(tag, world)``-scoped like the snapshot marker, so
  recovery after an N→M rescale re-assigns pending partitions through
  the shared ``shard_owner`` mint.

Correct by construction like every mesh protocol so far: the
stage/pre-commit/finalize/recover *decisions* are pure transitions in
``parallel/protocol.py`` that this module binds verbatim (identity
pinned by tests) and ``analysis/meshcheck.py --mesh --sink``
exhaustively model-checks over all crash interleavings — including a
rescale window. The seeded ``finalize_before_marker`` mutant (finalize
at pre-commit, before the marker lands) is the canonical 2PC bug and
must be caught with a minimal replayable trace.

What remains at-least-once: runs without ``OPERATOR_PERSISTING`` have
no snapshot marker to align with, so sinks finalize at every commit
timestamp (still torn-write-proof via atomic rename, but a crash loses
no committed marker to recover against — the run restarts from
scratch). ``pw.io.subscribe``/``on_batch`` consumers get a delivery
envelope ``(epoch, commit_ts, seq)`` so external systems can dedup that
remaining surface.
"""

from __future__ import annotations

import io as _io
import json as _json
import os
import re
import shutil
import time as _time
from typing import NamedTuple

from pathway_tpu_torch.internals import faults as _faults
from pathway_tpu_torch.parallel import protocol as _proto

# the shared transition table entries this module drives through — the
# SAME objects analysis/meshcheck.py explores (identity pinned by
# tests/test_txn_sinks.py, like NBDecision and the wave protocol)
SINK_MAY_FINALIZE = _proto.TRANSITIONS["sink_may_finalize"]
SINK_RECOVER = _proto.TRANSITIONS["sink_recover"]
SHARD_OWNER = _proto.TRANSITIONS["shard_owner"]


class DeliveryEnvelope(NamedTuple):
    """The delivery metadata handed to ``pw.io.subscribe(...,
    on_batch=..., with_envelope=True)`` consumers: ``epoch`` is the
    mesh recovery epoch the batch was emitted in (0 outside supervised
    meshes), ``commit_ts`` the engine commit timestamp (monotone across
    restarts — wall-clock-floored), and ``seq`` a per-subscription
    sequence number strictly monotone within one process incarnation.

    What it buys an external consumer of this at-least-once surface:
    ``(epoch, commit_ts)`` orders every delivery, and a REDELIVERY
    WINDOW is always detectable — a mesh rollback bumps ``epoch``, and
    any restart resets ``seq`` (a ``seq`` at-or-below the consumer's
    high-water for the same epoch marks the stream as rewound; note a
    non-mesh OPERATOR_PERSISTING restart keeps ``epoch`` 0, so the
    ``seq`` reset is the signal there). Within the window the engine
    re-emits the uncommitted suffix with FRESH timestamps, so exact
    dedup needs the consumer's own row keys (upserts) — or the
    transactional sinks, which do it below this API. Batches arriving
    with ``seq`` strictly above the high-water and no epoch change are
    guaranteed first deliveries and can be applied without any key
    lookup."""

    epoch: int
    commit_ts: int
    seq: int


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    return raw.strip().lower() not in ("0", "false", "no")


def _fsync_enabled() -> bool:
    return _env_bool("PATHWAY_SINK_FSYNC", True)


def txn_enabled() -> bool:
    """PATHWAY_SINK_TXN=0 disables epoch alignment entirely (sinks then
    finalize at every commit timestamp, still via atomic rename)."""
    return _env_bool("PATHWAY_SINK_TXN", True)


def _fsync_file(f) -> None:
    if _fsync_enabled():
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    """Durable rename point: fsync the containing directory so the
    rename itself survives power loss (best-effort — not every fs
    supports O_DIRECTORY fds)."""
    if not _fsync_enabled():
        return
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def note_egress_seconds(stats, name: str, seconds: float) -> None:
    """Per-sink egress-seconds accounting, shared by every
    transactional sink so the guard/label policy cannot diverge."""
    if stats is not None and hasattr(stats, "on_sink_egress_seconds"):
        stats.on_sink_egress_seconds(name, seconds)


def write_atomic(path: str, data: bytes) -> None:
    """THE torn-write fix: every finalization —
    and every plain-file sink write, even outside mesh mode — routes
    through write-temp + fsync + atomic rename, so a crash mid-write
    can never leave a partial file visible."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + f".pw-tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        _fsync_file(f)
    os.replace(tmp, path)
    _fsync_dir(d)


_SEG_RE = re.compile(
    r"^seg-e(\d+)-t(\d+)-(\d+)\.dat$"
)
_TAG_RE = re.compile(r"^t(\d+)$")


def seg_name(epoch: int, commit_ts: int, seq: int) -> str:
    """Staged-unit file name: the ``(epoch, commit-timestamp, seq)``
    key, zero-padded so lexicographic order IS delivery order (epochs
    are monotone across rollbacks, timestamps monotone within one)."""
    return f"seg-e{epoch:08d}-t{commit_ts:020d}-{seq:08d}.dat"


class TransactionalSink:
    """Protocol base for two-phase-commit sinks. The runtime drives the
    four verbs around its snapshot lifecycle (engine/runtime.py):

    * ``arm(stats, txn, rank, world, epoch)`` — once at run start;
      ``txn=False`` (no OPERATOR_PERSISTING cut to align with) makes
      ``on_time_end`` finalize immediately;
    * ``precommit(tag)`` — at the snapshot cut, BEFORE the
      ``snapshot_commit`` marker moves;
    * ``finalize(tag)`` — after the marker (and, on a mesh, the
      snapshot barrier) landed at ``tag``;
    * ``recover(marker_tag, world)`` — at restore, before any new data
      flows; also with ``marker_tag=None`` for a from-scratch start.

    ``abort_for_rollback()`` is the epoch-abort courtesy hook
    (io/_connector.py ``abort_sinks_for_rollback``): best-effort
    discard of un-pre-committed staging before the supervised exit —
    recovery would discard it anyway, this just reclaims disk early.
    """

    name: str = "sink"

    def arm(
        self, *, stats=None, txn=False, rank=0, world=1, epoch=0,
        lineage=None,
    ):
        """``lineage`` is the persistence store's egress lineage id
        (minted once per store; None outside epoch-aligned mode) —
        sinks whose dedup records outlive the persistence directory
        (the Delta ``txn`` appId) must scope them by it."""
        raise NotImplementedError

    def precommit(self, tag: int) -> None:
        raise NotImplementedError

    def finalize(self, tag: int) -> None:
        raise NotImplementedError

    def recover(self, marker_tag: int | None, world: int) -> None:
        raise NotImplementedError

    def abort_for_rollback(self) -> None:  # pragma: no cover - courtesy
        pass


class TxnFileSink(TransactionalSink):
    """Two-phase-commit file sink backing ``pw.io.fs/csv/jsonlines``
    writers.

    Layout for an output file ``F`` (all under ``F.pw-txn/``, or
    ``PATHWAY_SINK_STAGE_DIR`` when set):

    * ``final/`` — finalized segment files; the visible file ``F`` is
      the deterministic concatenation (header + segments in name
      order) republished atomically after every finalize;
    * ``stage/r{rank}/e{epoch}/open/`` — sealed-but-unpre-committed
      segments of the current epoch;
    * ``stage/r{rank}/e{epoch}/t{tag}/`` — the pre-committed set of
      cut ``tag`` (one atomic directory rename at pre-commit).

    Gather sinks are single-writer (rank 0 owns the file), but the
    recovery claim still routes through the shared ``shard_owner``
    mint over the sink's partition id so the behavior matches the
    partitioned (Delta) sinks and the model checker."""

    def __init__(self, filename: str, *, format: str = "csv", cols=()):
        self.filename = os.path.abspath(filename)
        self.format = format
        self.cols = list(cols)
        self.name = f"fs:{os.path.basename(filename)}"
        base = os.environ.get("PATHWAY_SINK_STAGE_DIR", "").strip()
        if base:
            # stage under a user-chosen root, keyed by the output's
            # basename + a short path hash so two outputs never collide
            import zlib as _zlib

            key = (
                f"{os.path.basename(self.filename)}-"
                f"{_zlib.crc32(self.filename.encode()) & 0xFFFFFFFF:08x}"
            )
            self.root = os.path.join(os.path.abspath(base), key)
        else:
            self.root = self.filename + ".pw-txn"
        self._txn = False
        self._rank = 0
        self._world = 1
        self._epoch = 0
        self._stats = None
        self._armed = False
        # incarnation token: names this process's open staging dir so a
        # recovery scan can tell LIVE staging (rows this incarnation
        # already sealed — e.g. program-embedded static rows injected
        # before the restore window) from a dead incarnation's
        # un-pre-committed leftovers, which no cut claims and which the
        # restored engine will re-emit (keeping them would duplicate)
        import uuid as _uuid

        self._incarnation = _uuid.uuid4().hex[:12]
        self._started = False  # lazy fresh-start for unarmed (static) runs
        self._buf: list[bytes] = []
        self._buf_time: int | None = None
        self._seg_seq = 0
        self._staged_tag = -1
        self._finalized_tag = -1

    # -- layout helpers ----------------------------------------------------

    def _final_dir(self) -> str:
        return os.path.join(self.root, "final")

    def _stage_dir(self, rank: int | None = None, epoch: int | None = None):
        p = os.path.join(self.root, "stage")
        if rank is not None:
            p = os.path.join(p, f"r{rank}")
            if epoch is not None:
                p = os.path.join(p, f"e{epoch:08d}")
        return p

    def _open_dir(self) -> str:
        return os.path.join(
            self._stage_dir(self._rank, self._epoch),
            f"open-{self._incarnation}",
        )

    def _header(self) -> bytes:
        if self.format == "csv":
            out = _io.StringIO()
            import csv as _csv

            _csv.writer(out).writerow(self.cols + ["time", "diff"])
            return out.getvalue().encode()
        return b""

    # -- encoding ----------------------------------------------------------

    def _encode(self, deltas, time: int) -> bytes:
        if self.format == "csv":
            out = _io.StringIO()
            import csv as _csv

            w = _csv.writer(out)
            for _k, row, d in deltas:
                w.writerow(list(row) + [time, d])
            return out.getvalue().encode()
        lines = []
        for _k, row, d in deltas:
            payload = dict(zip(self.cols, row))
            payload["time"] = time
            payload["diff"] = d
            lines.append(_json.dumps(payload, default=str))
        return ("\n".join(lines) + "\n").encode() if lines else b""

    def _encode_arrow(self, rb, time: int) -> bytes:
        """Serialize one Arrow record batch (value columns + ``diff``)
        straight off its columns — each column converts to a Python
        list in one C pass (pyarrow ``to_pylist``), so no engine row
        tuples ever exist; the byte output is IDENTICAL to
        ``_encode`` over the equivalent deltas (the parity battery
        pins it)."""
        col_vals = [
            rb.column(rb.schema.get_field_index(c)).to_pylist()
            for c in self.cols
        ]
        diffs = rb.column(rb.schema.get_field_index("diff")).to_pylist()
        if self.format == "csv":
            out = _io.StringIO()
            import csv as _csv

            w = _csv.writer(out)
            w.writerows(
                list(vals) + [time, d]
                for vals, d in zip(zip(*col_vals), diffs)
            )
            return out.getvalue().encode()
        lines = []
        for vals, d in zip(zip(*col_vals), diffs):
            payload = dict(zip(self.cols, vals))
            payload["time"] = time
            payload["diff"] = d
            lines.append(_json.dumps(payload, default=str))
        return ("\n".join(lines) + "\n").encode() if lines else b""

    def _note_egress(self, seconds: float) -> None:
        note_egress_seconds(self._stats, self.name, seconds)

    # -- engine callbacks --------------------------------------------------

    def on_batch(self, time: int, deltas) -> None:
        self._ensure_started()
        t0 = _time.perf_counter()
        data = self._encode(deltas, time)
        if data:
            self._buf.append(data)
            self._buf_time = time
        self._note_egress(_time.perf_counter() - t0)

    def on_batch_arrow(self, time: int, rb) -> None:
        """Columnar staging: the OutputNode delivers the
        fused chain's NativeBatch output as an Arrow record batch and
        the sink serializes it column-wise — no row round-trip."""
        self._ensure_started()
        t0 = _time.perf_counter()
        if rb is not None and rb.num_rows:
            data = self._encode_arrow(rb, time)
            if data:
                self._buf.append(data)
                self._buf_time = time
        self._note_egress(_time.perf_counter() - t0)

    def on_time_end(self, time: int) -> None:
        self._seal(time)
        if not self._txn:
            # no snapshot cut to align with: finalize immediately (the
            # documented at-least-once boundary outside OPERATOR_
            # PERSISTING), still torn-write-proof via atomic rename
            self._finalize_pending(marker_tag=None, unconditional=True)

    def on_end(self) -> None:
        self._ensure_started()
        if self._buf_time is not None:
            self._seal(self._buf_time)
        if not self._txn:
            self._finalize_pending(marker_tag=None, unconditional=True)
            self._publish()
            # from-scratch runs have nothing to recover against next
            # time: the segment store is garbage once published
            shutil.rmtree(self.root, ignore_errors=True)
        # txn mode: the runtime's final cut (snapshot + marker +
        # finalize) already drove the 2PC before on_end fires

    # -- the 2PC verbs -----------------------------------------------------

    def arm(
        self, *, stats=None, txn=False, rank=0, world=1, epoch=0,
        lineage=None,
    ):
        self._stats = stats
        self._txn = txn and txn_enabled()
        self._rank = rank
        self._world = world
        self._epoch = epoch
        self._armed = True
        if not self._txn and SHARD_OWNER(0, world) == rank:
            # from-scratch semantics — but ONLY the writer rank may
            # clear the shared staging root: a late-arming non-writer
            # rank must not race the writer's fresh output away
            self._fresh()
        self._started = True

    def _ensure_started(self) -> None:
        if self._started:
            return
        # unarmed (static / analyzer) run: from-scratch semantics
        self._fresh()
        self._started = True

    def _fresh(self) -> None:
        """From-scratch start (no committed cut to recover against):
        stale staging AND stale finalized segments from a previous run
        are discarded — the run regenerates everything."""
        shutil.rmtree(self.root, ignore_errors=True)

    def _seal(self, time: int) -> None:
        """Stage the buffered rows of commit ``time`` as one durable
        segment file. Staged output is invisible until finalized."""
        if not self._buf:
            return
        self._ensure_started()
        _faults.fault_point("sink.stage", rank=self._rank)
        data = b"".join(self._buf)
        self._buf = []
        self._buf_time = None
        self._seg_seq += 1
        name = seg_name(self._epoch, time, self._seg_seq)
        d = self._open_dir()
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(data)
            _fsync_file(f)
        os.replace(tmp, os.path.join(d, name))
        _fsync_dir(d)
        if self._stats is not None:
            self._stats.on_sink_staged(self.name)
            self._note_lag()

    def heap_nbytes(self) -> int:
        """Bytes of encoded-but-unsealed rows buffered in memory — the
        memory accountant's ``txn_staging`` component.
        Sealed/staged units live on DISK and are deliberately not
        counted: the watermark ladder governs heap, not the lake."""
        return sum(len(b) for b in self._buf)

    def precommit(self, tag: int) -> None:
        """Freeze the staged set under the cut's tag BEFORE the marker
        moves: one atomic directory rename (open -> t{tag}). Runs on
        every rank inside the snapshot collective window, so the set
        the marker commits can never change after the marker lands."""
        if not self._txn:
            return
        if self._buf_time is not None:
            self._seal(self._buf_time)
        open_dir = self._open_dir()
        if not os.path.isdir(open_dir) or not os.listdir(open_dir):
            self._staged_tag = max(self._staged_tag, tag)
            return
        dst = os.path.join(
            self._stage_dir(self._rank, self._epoch), f"t{tag:020d}"
        )
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if os.path.isdir(dst):
            # a retried cut at the same tag: merge (segment names are
            # globally unique, so plain moves cannot collide)
            for n in os.listdir(open_dir):
                os.replace(os.path.join(open_dir, n), os.path.join(dst, n))
            os.rmdir(open_dir)
        else:
            os.replace(open_dir, dst)
        _fsync_dir(os.path.dirname(dst))
        self._staged_tag = max(self._staged_tag, tag)
        self._note_lag()

    def finalize(self, tag: int) -> None:
        """The marker landed at ``tag``: staged units at-or-below it
        become externally visible. Driven per unit through the shared
        ``sink_may_finalize`` transition — the same function the model
        checker explores (and the ``finalize_before_marker`` mutant
        breaks). Single-writer: only the owner of the sink's partition
        (rank 0 of a gather sink) touches the visible file — every
        other rank stages nothing and must not race the publish."""
        if not self._txn:
            return
        self._finalized_tag = max(self._finalized_tag, tag)
        self._note_lag()
        if SHARD_OWNER(0, self._world) != self._rank:
            return
        if self._finalize_pending(marker_tag=tag):
            # republish only when segments actually finalized: a quiet
            # cut must not rewrite the whole committed file (recover()
            # keeps its unconditional publish for crash convergence)
            self._publish()

    def recover(self, marker_tag: int | None, world: int) -> None:
        """Restore-time scan of pending staged output: one shared
        ``sink_recover`` verdict per unit — finalize everything the
        committed cut covers, discard the rest (including dead-epoch
        ``open`` staging). Idempotent: a second recovery finds nothing
        pending and republishes the identical file. The claim routes
        through ``shard_owner`` over the staged partition id, so after
        an N→M rescale the pending partitions of dead ranks are
        re-owned deterministically by exactly one rank of the new
        world."""
        self._armed = True
        self._started = True
        self._world = world
        _faults.fault_point("sink.recover", rank=self._rank)
        stage_root = self._stage_dir()
        recovered = aborted = 0
        if os.path.isdir(stage_root):
            for rdir in sorted(os.listdir(stage_root)):
                if not rdir.startswith("r"):
                    continue
                try:
                    partition = int(rdir[1:])
                except ValueError:
                    continue
                if SHARD_OWNER(partition, world) != self._rank:
                    continue  # another rank of this world owns it
                rpath = os.path.join(stage_root, rdir)
                for edir in sorted(os.listdir(rpath)):
                    epath = os.path.join(rpath, edir)
                    for unit in sorted(os.listdir(epath)):
                        upath = os.path.join(epath, unit)
                        m = _TAG_RE.match(unit)
                        if m is None:
                            if (
                                unit == f"open-{self._incarnation}"
                                and marker_tag is None
                            ):
                                # THIS incarnation's live staging on a
                                # from-scratch start (static rows sealed
                                # before the restore window) — a later
                                # cut will pre-commit it
                                continue
                            # discard: either a dead incarnation's
                            # un-pre-committed staging (no cut claims
                            # it), or THIS incarnation's pre-restore
                            # staging under a committed marker — the
                            # only rows staged before recovery are the
                            # re-injected static rows, which the
                            # restored cut already committed (keeping
                            # them would duplicate them every restart)
                            aborted += self._count_segs(upath)
                            shutil.rmtree(upath, ignore_errors=True)
                            continue
                        unit_tag = int(m.group(1))
                        verdict = SINK_RECOVER(unit_tag, marker_tag)
                        if verdict == "finalize":
                            recovered += self._adopt_unit(upath)
                        else:
                            aborted += self._count_segs(upath)
                            shutil.rmtree(upath, ignore_errors=True)
        if marker_tag is None and SHARD_OWNER(0, world) == self._rank:
            # nothing committed: the restored engine re-emits everything,
            # so previously finalized output must go too
            n = 0
            fdir = self._final_dir()
            if os.path.isdir(fdir):
                n = len(os.listdir(fdir))
            shutil.rmtree(fdir, ignore_errors=True)
            aborted += n
        if SHARD_OWNER(0, world) == self._rank:
            self._publish()
        if self._stats is not None:
            if recovered:
                self._stats.on_sink_recovered(self.name, recovered)
            if aborted:
                self._stats.on_sink_aborted(self.name, aborted)
        if marker_tag is not None:
            self._finalized_tag = max(self._finalized_tag, marker_tag)
            self._staged_tag = max(self._staged_tag, marker_tag)
        self._note_lag()

    def abort_for_rollback(self) -> None:
        """Epoch abort: discard this epoch's un-pre-committed staging
        (recovery would discard it anyway — this reclaims it early and
        makes the abort observable on the counters)."""
        d = self._open_dir()
        n = self._count_segs(d)
        shutil.rmtree(d, ignore_errors=True)
        self._buf = []
        self._buf_time = None
        if n and self._stats is not None:
            self._stats.on_sink_aborted(self.name, n)

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _count_segs(path: str) -> int:
        try:
            return sum(
                1 for n in os.listdir(path) if _SEG_RE.match(n)
            )
        except OSError:
            return 0

    def _adopt_unit(self, unit_dir: str) -> int:
        """Move a pending unit's segments into final/ (atomic per-file
        renames; already-present names are skipped, which is what makes
        a crash mid-finalize — and a double recovery — idempotent)."""
        fdir = self._final_dir()
        os.makedirs(fdir, exist_ok=True)
        n = 0
        for name in sorted(os.listdir(unit_dir)):
            if not _SEG_RE.match(name):
                continue
            dst = os.path.join(fdir, name)
            if not os.path.exists(dst):
                os.replace(os.path.join(unit_dir, name), dst)
                n += 1
        _fsync_dir(fdir)
        shutil.rmtree(unit_dir, ignore_errors=True)
        return n

    def _pending_units(self):
        """(tag, path) of this rank+epoch's pre-committed units."""
        d = self._stage_dir(self._rank, self._epoch)
        if not os.path.isdir(d):
            return []
        out = []
        for unit in sorted(os.listdir(d)):
            m = _TAG_RE.match(unit)
            if m is not None:
                out.append((int(m.group(1)), os.path.join(d, unit)))
        return out

    def _finalize_pending(
        self, marker_tag: int | None, unconditional: bool = False
    ) -> int:
        n = 0
        # unconditional path (non-txn): everything sealed moves straight
        # to final — the open dir is the only staging that exists
        if unconditional:
            d = self._open_dir()
            if os.path.isdir(d) and os.listdir(d):
                _faults.fault_point("sink.finalize", rank=self._rank)
                n += self._adopt_unit(d)
                self._publish()
        else:
            for unit_tag, upath in self._pending_units():
                if SINK_MAY_FINALIZE(unit_tag, marker_tag):
                    _faults.fault_point("sink.finalize", rank=self._rank)
                    n += self._adopt_unit(upath)
        if n and self._stats is not None:
            self._stats.on_sink_finalized(self.name, n)
        return n

    def _publish(self) -> None:
        """Republish the visible file by STREAMING the finalized
        segment store (header + segments in name order) into a temp
        file, fsync, atomic rename — O(1) memory no matter how large
        the committed output grows, deterministic, and convergent after
        any crash. The whole-file rewrite is the torn-write guarantee;
        per-cut write amplification is O(committed output), which suits
        committed aggregates and bounded outputs — unbounded raw-volume
        streams should prefer the append-only Delta sink."""
        d = os.path.dirname(self.filename)
        os.makedirs(d, exist_ok=True)
        tmp = self.filename + f".pw-tmp-{os.getpid()}"
        with open(tmp, "wb") as out:
            out.write(self._header())
            fdir = self._final_dir()
            if os.path.isdir(fdir):
                for name in sorted(os.listdir(fdir)):
                    if not _SEG_RE.match(name):
                        continue
                    with open(os.path.join(fdir, name), "rb") as seg:
                        shutil.copyfileobj(seg, out)
            _fsync_file(out)
        os.replace(tmp, self.filename)
        _fsync_dir(d)

    def _note_lag(self) -> None:
        if self._stats is not None and self._txn:
            self._stats.on_sink_epoch_lag(
                self.name,
                max(0, self._staged_tag - self._finalized_tag),
            )
